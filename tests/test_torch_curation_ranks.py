"""The port's curation over two processes, on the CPU.

Two ranks run as spawned processes over gloo, as `tests/test_torch_ddp.py`
launches them (a `FileStore` under `tmp_path`, each spawn bounded by
`RANK_TIMEOUT`), with the real towers (small widths, real input geometry)
on one seeded state dict. `encode_files_striped` and `curate_library` must
give every rank what one process gives (the same kept files in the same
order, embeddings within 1e-6, the same tree, complete when any rank
returns), with a corrupt WAV inside one stripe; and with `skip_errors=False`
that WAV must fail both ranks, naming the rank that failed.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from adt_str_tpu_torch.clap import curation as tcur
from adt_str_tpu_torch.clap import model as tmodel
from adt_str_tpu_torch.parallel import mesh as tmesh
from adt_str_tpu_torch.utils.audio_io import write_wav
from test_torch_clap import REAL_INPUT_AUDIO, archs
from test_torch_curation import CLAP_SR, tone, tree
from test_torch_ddp import init_gloo, run_ranks


def wrapper():
    (ta, tt), _ = archs(REAL_INPUT_AUDIO)
    return tmodel.ClapWrapper("unused", state_dict=tmodel.random_state_dict(ta, tt, seed=4), audio_arch=ta,
                              text_arch=tt, device="cpu")


def build(root: Path) -> tuple[Path, Path, list[str]]:
    """Reference classes 35 and 42 (two tones each), a library of 7 tones
    and, as its 6th file (rank 1's stripe), a corrupt WAV."""
    ref = root / "reference"
    for cls, freqs in [(35, (80, 120)), (42, (2500, 3500))]:
        (ref / str(cls)).mkdir(parents=True)
        for j, f in enumerate(freqs):
            write_wav(ref / str(cls) / f"r{j}.wav", tone(f, sr=CLAP_SR), CLAP_SR)
    lib = root / "library"
    lib.mkdir()
    for i, f in enumerate([90, 3000, 150, 2000, 110, 60, 4000]):
        write_wav(lib / f"s{i if i < 5 else i + 1}.wav", tone(f, sec=0.1 + 0.05 * i, sr=CLAP_SR), CLAP_SR)
    (lib / "s5.wav").write_bytes(b"RIFFnotawav" * 3)
    return ref, lib, sorted(str(p) for p in lib.glob("*.wav"))


def _curation_rank(rank: int, world: int, store: str, job_path: str, out_path: str) -> None:
    init_gloo(rank, world, store)
    torch.set_num_threads(1)
    try:
        job = torch.load(job_path, weights_only=False)
        w = wrapper()
        mesh = tmesh.make_mesh(devices=["cpu"])
        out: dict = {}
        emb, kept = tcur.encode_files_striped(w, job["files"], CLAP_SR, batch_size=2, mesh=mesh)
        out["striped"] = (emb, kept)
        try:
            tcur.encode_files_striped(w, job["files"], CLAP_SR, batch_size=2, mesh=mesh, skip_errors=False)
            out["fail"] = None
        except RuntimeError as e:
            out["fail"] = str(e)
        # no mesh: the curation makes its own from the process group
        root = tcur.curate_library(w, job["library"], job["reference"], sample_rate=CLAP_SR, batch_size=2)
        out["tree"] = tree(root)  # read at once: the tree must be complete when any rank returns
        torch.save(out, out_path)
    finally:
        tmesh.destroy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("curation_ranks")
    ref, lib, files = build(tmp / "ranks")
    outs = run_ranks(_curation_rank, tmp / "spawn",
                     {"files": files, "library": str(lib), "reference": str(ref)})
    return outs, build(tmp / "one")


def test_striped_encode_equals_one_process(ranks):
    outs, (_, _, files) = ranks
    emb, kept = tcur.encode_files(wrapper(), files, CLAP_SR, batch_size=2)
    assert len(kept) == 7 and not any(f.endswith("s5.wav") for f in kept)
    for r, out in enumerate(outs):
        r_emb, r_kept = out["striped"]
        assert [Path(f).name for f in r_kept] == [Path(f).name for f in kept], r
        np.testing.assert_allclose(r_emb, emb, atol=1e-6, rtol=0)


def test_a_failed_stripe_fails_every_rank(ranks):
    outs, _ = ranks
    for out in outs:
        assert out["fail"] is not None and "stripe encode" in out["fail"] and "process(es) [1]" in out["fail"]


def test_curate_library_over_ranks_equals_one_process(ranks):
    outs, (ref, lib, _) = ranks
    root = tcur.curate_library(wrapper(), str(lib), str(ref), sample_rate=CLAP_SR, batch_size=2)
    expect = tree(root)
    assert len(expect) == 7 and {p.split("/")[0] for p in expect} == {"35", "42"}
    for r, out in enumerate(outs):
        assert out["tree"] == expect, r
