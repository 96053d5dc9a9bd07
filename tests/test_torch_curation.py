"""The port's curation (`adt_str_tpu_torch/clap/curation.py`) against the JAX
package's, in one process on the CPU.

Mirrors `tests/test_curation.py` and the one-process cases of
`tests/test_curation_sharded.py`: the same synthetic trees of WAVs go through
both packages, with the stub encoder (8 spectral-band energies) or with the
real towers on one seeded state dict (the small widths at the real input
geometry), and the output trees must be equal: each file in the same
`<class>/<bin>/`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from adt_str_tpu.clap import curation as jcur
from adt_str_tpu.clap import model as jmodel
from adt_str_tpu_torch.clap import curation as tcur
from adt_str_tpu_torch.clap import model as tmodel
from adt_str_tpu_torch.parallel.mesh import make_mesh
from adt_str_tpu_torch.synth.bank import load_bank_hdf5
from adt_str_tpu_torch.utils.audio_io import write_wav
from test_torch_clap import archs, numpy_sd, REAL_INPUT_AUDIO

SR = 8000
CLAP_SR = 48_000


class StubWrapper:
    """Deterministic 'embeddings': 8 spectral-band energies, L2-normed (the
    JAX package's curation tests' stub), on the CPU."""

    device = torch.device("cpu")

    def get_audio_features(self, audios, mesh=None):
        out = []
        for a in audios:
            spec = np.abs(np.fft.rfft(np.asarray(a).reshape(-1), n=256))
            bands = spec[:128].reshape(8, -1).sum(axis=1)
            out.append(bands / (np.linalg.norm(bands) + 1e-8))
        return np.stack(out)


def tone(freq, sec=0.2, sr=SR):
    t = np.arange(int(sec * sr)) / sr
    return (0.8 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def tree(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*.wav"))


def build_tree(root: Path, sr: int = SR, stray: bool = False) -> tuple[Path, Path]:
    """Reference classes 35 (low tone) and 42 (high tone), a library of
    three tones; with `stray`, WAVs outside the reference classes and a
    corrupt library file."""
    ref = root / "GM_ref"
    for pitch, freq in [(35, 100), (42, 3000)]:
        (ref / str(pitch)).mkdir(parents=True)
        write_wav(ref / str(pitch) / f"ref_{pitch}.wav", tone(freq, sr=sr), sr)
    lib = root / "library"
    lib.mkdir()
    for name, freq in [("low1", 110), ("low2", 90), ("high1", 2800)]:
        write_wav(lib / f"{name}.wav", tone(freq, sr=sr), sr)
    if stray:
        for d, name in [("extra", "x"), ("90", "y")]:  # not a directory, not a reference class
            (ref / d).mkdir()
            write_wav(ref / d / f"{name}.wav", tone(500, sr=sr), sr)
        (lib / "corrupt.wav").write_bytes(b"RIFFnotawav" * 3)
    return ref, lib


@pytest.fixture
def two_trees(tmp_path):
    """One tree for each package (the output lands beside the reference)."""
    return build_tree(tmp_path / "port"), build_tree(tmp_path / "jax")


def test_score_to_bin_label_matches_jax():
    scores = [*np.linspace(-1.2, 1.2, 481), -1.0, 1.0, 0.0, 0.81, 0.8, 0.79999, 0.6]
    for num_bins in (1, 2, 4, 5, 10, 20, 25, 50, 100):
        assert [tcur.score_to_bin_label(float(s), num_bins) for s in scores] == \
               [jcur.score_to_bin_label(float(s), num_bins) for s in scores]
    assert tcur.score_to_bin_label(0.95) == "100-90" and tcur.score_to_bin_label(0.3, num_bins=5) == "80-60"


@pytest.mark.parametrize("num_bins", [0, 3, 7, -10])
def test_invalid_num_bins_raise(num_bins):
    with pytest.raises(ValueError, match="divides 100"):
        tcur.validate_num_bins(num_bins)


def test_sort_paths_by_parent_folder_matches_jax():
    paths = ["/x/40/b.wav", "/x/35/a.wav", "/x/421/c.wav", "/x/misc/d.wav", "/x/35/A0.wav"]
    assert tcur.sort_paths_by_parent_folder(paths) == jcur.sort_paths_by_parent_folder(paths)
    assert tcur.REFERENCE_CLASSES == jcur.REFERENCE_CLASSES
    assert tcur._augmented_root_for("/d/GM/") == jcur._augmented_root_for("/d/GM/") == Path("/d/GM_clap_augmented")


def test_assign_classes_matches_jax_and_the_global_sort():
    """Indices equal, scores within 1e-6 of JAX's `precision="highest"`
    product (fp32 on both sides); and equal to the reference's global
    descending sort with first-occurrence assignment."""
    rng = np.random.default_rng(0)
    U = rng.normal(size=(50, 16)).astype(np.float32)
    C = rng.normal(size=(5, 16)).astype(np.float32)
    idx, score = tcur.assign_classes(U, C, device="cpu")
    jidx, jscore = jcur.assign_classes(U, C)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(score, np.asarray(jscore), atol=1e-6, rtol=0)
    u_n = U / np.linalg.norm(U, axis=1, keepdims=True)
    c_n = C / np.linalg.norm(C, axis=1, keepdims=True)
    order = sorted(((ci, si, float(s)) for ci in range(len(C)) for si, s in enumerate(u_n @ c_n[ci])),
                   key=lambda x: x[2], reverse=True)
    seen: dict = {}
    for ci, si, s in order:
        seen.setdefault(si, ci)
    np.testing.assert_array_equal(idx, [seen[i] for i in range(len(U))])


def test_assign_classes_over_a_mesh_equals_one_device():
    rng = np.random.default_rng(1)
    U = rng.normal(size=(37, 8)).astype(np.float32)  # 37 rows: padded to 38 over two entries
    C = rng.normal(size=(3, 8)).astype(np.float32)
    i1, s1 = tcur.assign_classes(U, C, device="cpu")
    i2, s2 = tcur.assign_classes(U, C, mesh=make_mesh(devices=["cpu", "cpu"]))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)


def test_assign_classes_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tcur.assign_classes(np.ones((2, 4), np.float32), np.ones((1, 4), np.float32))


def test_curate_library_end_to_end_matches_jax(two_trees, tmp_path):
    (ref, lib), (jref, jlib) = two_trees
    out = tcur.curate_library(StubWrapper(), str(lib), str(ref), sample_rate=SR, batch_size=2)
    jout = jcur.curate_library(StubWrapper(), str(jlib), str(jref), sample_rate=SR, batch_size=2)
    assert tree(out) == tree(jout)
    assert sorted(p.name for p in out.rglob("*.wav")) == ["high1.wav", "low1.wav", "low2.wav"]
    assert len(list((out / "35").rglob("low*.wav"))) == 2 and len(list((out / "42").rglob("high*.wav"))) == 1

    # the gold bins, then the bank file the synthesiser loads
    tcur.copy_originals_to_augmented(str(ref), out)
    jcur.copy_originals_to_augmented(str(jref), jout)
    assert tree(out) == tree(jout) and (out / "35" / "gold" / "ref_35.wav").exists()
    h5 = tcur.convert_augmented_to_hdf5(str(out), str(tmp_path / "bank"), SR)
    bank = load_bank_hdf5(str(h5), max_len=SR)
    assert set(bank.pitches()) == {35, 42}
    assert bank.bin_count[35, 0] == 1 and bank.bin_count.sum() == 5


def test_curation_robust_to_corrupt_and_stray_files(tmp_path):
    """A corrupt library WAV is skipped and stray reference WAVs are left out
    before the embedding pass, as the JAX package does."""
    ref, lib = build_tree(tmp_path / "port", stray=True)
    jref, jlib = build_tree(tmp_path / "jax", stray=True)
    out = tcur.curate_library(StubWrapper(), str(lib), str(ref), sample_rate=SR, batch_size=2)
    jout = jcur.curate_library(StubWrapper(), str(jlib), str(jref), sample_rate=SR, batch_size=2)
    assert tree(out) == tree(jout)
    names = [Path(p).name for p in tree(out)]
    assert "corrupt.wav" not in names and "x.wav" not in names and "y.wav" not in names


def test_encode_files_pads_batches_and_reports_kept(tmp_path):
    """Every batch is padded to `batch_size` (the last holds one file and a
    silence row); `kept_files` carries the skip-aware alignment; the
    embeddings equal the JAX package's on the same stub."""
    _, lib = build_tree(tmp_path, stray=True)
    files = sorted(str(p) for p in lib.glob("*.wav"))  # 4 files, one corrupt
    sizes = []

    class SizeSpy(StubWrapper):
        def get_audio_features(self, audios, mesh=None):
            sizes.append(len(audios))
            return super().get_audio_features(audios)

    for workers in (1, 4):
        sizes.clear()
        emb, kept = tcur.encode_files(SizeSpy(), files, SR, batch_size=2, num_workers=workers)
        jemb, jkept = jcur.encode_files(StubWrapper(), files, SR, batch_size=2, num_workers=workers)
        assert set(sizes) == {2} and len(sizes) == 2
        assert kept == jkept == [f for f in files if not f.endswith("corrupt.wav")]
        np.testing.assert_array_equal(emb, jemb)
    with pytest.raises(ValueError):
        tcur.encode_files(StubWrapper(), files, SR, batch_size=2, skip_errors=False)


def test_encode_files_over_a_mesh_rounds_the_batch(tmp_path):
    """batch_size 3 over two entries becomes 4; one process's striped
    encode is `encode_files` with the mesh passed through."""
    _, lib = build_tree(tmp_path)
    files = sorted(str(p) for p in lib.glob("*.wav"))
    calls = []

    class Spy(StubWrapper):
        def get_audio_features(self, audios, mesh=None):
            calls.append((len(audios), mesh is not None))
            return super().get_audio_features(audios)

    mesh = make_mesh(devices=["cpu", "cpu"])
    emb_mesh, kept_mesh = tcur.encode_files_striped(Spy(), files, SR, batch_size=3, mesh=mesh)
    emb, kept = tcur.encode_files(Spy(), files, SR, batch_size=3)
    assert set(calls) == {(4, True), (3, False)}
    assert kept_mesh == kept == files
    np.testing.assert_array_equal(emb_mesh, emb)


def test_curate_library_with_the_towers_matches_jax(tmp_path):
    """The real towers (small widths, real input geometry) on one seeded
    state dict, 48 kHz tones: the port (CPU) and the JAX package write the
    same tree."""
    (ta, tt), (ja, jt) = archs(REAL_INPUT_AUDIO)
    sd = tmodel.random_state_dict(ta, tt, seed=3)
    port = tmodel.ClapWrapper("unused", state_dict=sd, audio_arch=ta, text_arch=tt, device="cpu")
    ref_wrapper = jmodel.ClapWrapper("unused", state_dict=numpy_sd(sd), audio_arch=ja, text_arch=jt)
    ref, lib = build_tree(tmp_path / "port", sr=CLAP_SR)
    jref, jlib = build_tree(tmp_path / "jax", sr=CLAP_SR)
    out = tcur.curate_library(port, str(lib), str(ref), sample_rate=CLAP_SR, batch_size=2)
    jout = jcur.curate_library(ref_wrapper, str(jlib), str(jref), sample_rate=CLAP_SR, batch_size=2)
    assert len(tree(out)) == 3 and tree(out) == tree(jout)
    emb, _ = tcur.encode_files(port, sorted(str(p) for p in lib.glob("*.wav")), CLAP_SR, batch_size=2)
    jemb, _ = jcur.encode_files(ref_wrapper, sorted(str(p) for p in jlib.glob("*.wav")), CLAP_SR, batch_size=2)
    np.testing.assert_allclose(emb, jemb, atol=1e-5, rtol=0)
