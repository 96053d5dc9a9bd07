"""CLAP-based one-shot library curation.

Port of `adt_str_tpu/clap/curation.py`:

- the reference set G: WAVs grouped by their parent directory's pitch
  (`REFERENCE_CLASSES`: 35-81 and 421, the electric hi-hat), batched CLAP
  audio embedding, the mean of each class;
- the unstructured library U: batched embedding, the WAVs decoded on a
  thread pool ahead of the encode, every batch padded with silence rows to
  `batch_size` (the towers' cuBLAS products pick their algorithm by the
  batch, so a ragged last batch could move its embeddings);
- assignment: `class = argmax_c cos(sample, mean_c)` with the score
  `max_c cos`, which is what the reference's global descending sort with
  first-occurrence copying computes; one true fp32 (U, D) x (D, C) product;
- binning: cosine [-1, 1] -> percent, labels `upper-lower` ("100-90", ...);
  `num_bins` must divide 100;
- each sample copied once into `<reference_root>_clap_augmented/<class>/<bin>`.

Over torchrun ranks (`parallel/mesh.py`) each rank encodes a stripe of the
files, the embeddings are all-gathered back to the files' order on every
rank, a failure on any rank raises on all of them (`_allgather_ok`), and
rank 0 alone writes the output tree, behind a barrier.
"""

from __future__ import annotations

import logging
import os
import shutil
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.parallel import mesh as mesh_lib
from adt_str_tpu_torch.utils.audio_io import load_and_resample, normalize
from adt_str_tpu_torch.utils.misc import fp32_products

logger = logging.getLogger(__name__)

REFERENCE_CLASSES = list(range(35, 82)) + [421]  # 421 = electric hi-hat


def sort_paths_by_parent_folder(file_paths: Sequence[str]) -> list[str]:
    def sort_key(path):
        parent_name = Path(path).parent.name
        try:
            return (0, int(parent_name), Path(path).name.lower())
        except ValueError:
            return (1, parent_name, Path(path).name.lower())

    return sorted(file_paths, key=sort_key)


def validate_num_bins(num_bins: int) -> None:
    """The one home of the bin rule: the CLI calls it before the model
    loads, so a bad value fails at once."""
    if num_bins <= 0 or 100 % num_bins != 0:
        raise ValueError("num_bins must be a positive integer that divides 100 evenly")


def _augmented_root_for(reference_root: str | Path) -> Path:
    """`<reference_root>_clap_augmented`, a sibling of the reference tree
    (through Path, so a trailing slash cannot nest it, and its rmtree,
    inside the reference tree)."""
    ref = Path(reference_root)
    return ref.with_name(ref.name + "_clap_augmented")


def score_to_bin_label(score_value: float, num_bins: int = 10) -> str:
    """cosine [-1, 1] -> the 'upper-lower' percentage bin."""
    bin_size = 100 // num_bins
    pct = int(round((max(min(score_value, 1.0), -1.0) + 1.0) * 50.0))
    bin_idx = min(pct // bin_size, num_bins - 1)
    return f"{(bin_idx + 1) * bin_size}-{bin_idx * bin_size}"


def encode_files(
    wrapper,
    files: Sequence[str],
    sample_rate: int,
    batch_size: int,
    num_workers: int | None = None,
    skip_errors: bool = True,
    mesh=None,
) -> tuple[np.ndarray, list[str]]:
    """Batched CLAP embedding of audio files -> ((K, D), kept_files).

    With more than one host core (`num_workers` defaults to min(16,
    cpu_count)) the decode and resample run on a thread pool up to 3
    batches ahead of the encode; `num_workers <= 1` is the plain serial
    loop. Unreadable files are logged and skipped (K <= N, `kept_files`
    carries the alignment); `skip_errors=False` raises on the first. Every
    batch is padded with silence rows to exactly `batch_size`.

    With `mesh` each batch is split over its local entries
    (`ClapWrapper.get_audio_features(mesh=)`), `batch_size` rounded up to a
    multiple of them. Over ranks, use `encode_files_striped`.
    """
    if num_workers is None:
        num_workers = min(16, os.cpu_count() or 1)
    if mesh is not None:
        n_data = len(mesh.devices)
        batch_size = -(-batch_size // n_data) * n_data

    def load(f):
        try:
            return normalize(load_and_resample(f, sample_rate))
        except Exception as e:  # noqa: BLE001 - corrupt files are expected at scale
            if not skip_errors:
                raise
            logger.warning("skipping unreadable %s: %s", f, e)
            return None

    out: list[np.ndarray] = []
    kept: list[str] = []
    n = len(files)

    def encode(waves: list[np.ndarray], names: list[str]) -> None:
        if not waves:
            return
        padded = list(waves) + [np.zeros(1024, np.float32)] * (batch_size - len(waves))
        emb = wrapper.get_audio_features(padded) if mesh is None else wrapper.get_audio_features(padded, mesh=mesh)
        out.append(np.asarray(emb)[: len(waves)])
        kept.extend(names)
        if (len(kept) // batch_size) % 50 == 0:
            logger.info("encoded %d/%d", len(kept), n)

    if num_workers <= 1:
        waves, names = [], []
        for f in files:
            w = load(f)
            if w is None:
                continue
            waves.append(w)
            names.append(f)
            if len(waves) == batch_size:
                encode(waves, names)
                waves, names = [], []
        encode(waves, names)
    else:
        prefetch = batch_size * 3  # decode up to 3 batches ahead of the device
        with ThreadPoolExecutor(num_workers) as pool:
            futs: deque = deque()
            idx = 0
            waves, names = [], []
            while idx < n or futs:
                while idx < n and len(futs) < prefetch:
                    futs.append((pool.submit(load, files[idx]), files[idx]))
                    idx += 1
                while futs and len(waves) < batch_size:
                    fut, name = futs.popleft()
                    w = fut.result()
                    if w is None:
                        continue
                    waves.append(w)
                    names.append(name)
                if len(waves) == batch_size or (not futs and idx >= n):
                    encode(waves, names)
                    waves, names = [], []
    if not out:
        return np.zeros((0, 512), np.float32), []
    return np.concatenate(out, axis=0), kept


def _process_mesh(wrapper, mesh) -> Optional[mesh_lib.DataMesh]:
    """The data axis over the ranks, or None in one process: `mesh` when it
    spans a process group, else a mesh of the wrapper's device in the group
    torchrun's environment made."""
    if mesh is not None and mesh.group is not None and mesh.world > 1:
        return mesh
    if dist.is_initialized() and dist.get_world_size() > 1:
        return mesh_lib.make_mesh(devices=[wrapper.device])
    return None


def _allgather_ok(mesh: mesh_lib.DataMesh, err: str | None, stage: str, width: int = 0) -> int:
    """Failure-propagating barrier: every rank sends an ok/failed flag, and
    if any rank failed, every rank raises (a rank that raised before a
    collective would leave the others waiting in it). It also gathers
    `width` (a rank's embedding width, 0 when it kept no file) and returns
    the largest."""
    mine = torch.tensor([[0 if err is None else 1, width]], dtype=torch.int64, device=mesh.device)
    got = mesh.all_gather_rows(mine).cpu().numpy()
    if got[:, 0].sum():
        bad = np.nonzero(got[:, 0])[0].tolist()
        raise RuntimeError(f"curation stage '{stage}' failed on process(es) {bad}"
                           + (f": {err}" if err else " (see that process's log for the error)"))
    return int(got[:, 1].max())


def encode_files_striped(
    wrapper,
    files: Sequence[str],
    sample_rate: int,
    batch_size: int,
    num_workers: int | None = None,
    skip_errors: bool = True,
    mesh=None,
) -> tuple[np.ndarray, list[str]]:
    """`encode_files` over ranks: rank p encodes `files[p::P]` on its own
    device and decode pool, then every rank all-gathers the stripes' rows
    (padded to the largest stripe) and puts them back in `files`' order, so
    every rank returns the same (embeddings, kept_files) as one process
    would (the batches are padded to the same size either way). In one
    process it is `encode_files` with `mesh` passed through. `files` must
    be in the same order on every rank (sort the globs)."""
    pmesh = _process_mesh(wrapper, mesh)
    if pmesh is None:
        return encode_files(wrapper, files, sample_rate, batch_size, num_workers=num_workers,
                            skip_errors=skip_errors, mesh=mesh)
    pidx, n_proc = pmesh.rank, pmesh.world
    stripe = list(files[pidx::n_proc])
    stripe_idx = np.arange(pidx, len(files), n_proc, dtype=np.int64)
    err: str | None = None
    try:
        emb, kept = encode_files(wrapper, stripe, sample_rate, batch_size, num_workers=num_workers,
                                 skip_errors=skip_errors)
        position = {f: i for i, f in enumerate(stripe)}
        kept_global_idx = np.asarray([stripe_idx[position[f]] for f in kept], dtype=np.int64)
    except Exception as e:  # noqa: BLE001 - every rank must still reach the gather (_allgather_ok)
        logger.exception("stripe encode failed on process %d", pidx)
        err = f"{type(e).__name__}: {e}"
        emb, kept_global_idx = np.zeros((0, 0), np.float32), np.zeros((0,), np.int64)
    width = _allgather_ok(pmesh, err, "stripe encode", emb.shape[1] if len(emb) else 0) or 512

    rows_max = -(-len(files) // n_proc)
    emb_pad = torch.zeros((rows_max, width), dtype=torch.float32)
    emb_pad[: len(emb)] = torch.from_numpy(np.asarray(emb, np.float32))
    idx_pad = torch.full((rows_max,), -1, dtype=torch.int64)
    idx_pad[: len(kept_global_idx)] = torch.from_numpy(kept_global_idx)
    emb_all = pmesh.all_gather_rows(emb_pad.to(pmesh.device)).cpu().numpy()
    idx_all = pmesh.all_gather_rows(idx_pad.to(pmesh.device)).cpu().numpy()
    keep = idx_all >= 0
    order = np.argsort(idx_all[keep], kind="stable")
    kept_files = [files[int(i)] for i in idx_all[keep][order]]
    return emb_all[keep][order], kept_files


def reference_class_means(wrapper, reference_root: str, sample_rate: int, batch_size: int,
                          mesh=None) -> tuple[np.ndarray, list[int]]:
    """-> (C, D) per-class mean embeddings and the class labels (non-empty
    classes only). WAVs outside a reference class's directory are warned
    about and left out before the embedding pass."""
    all_files = sort_paths_by_parent_folder(glob(f"{reference_root}/**/*.[Ww][Aa][Vv]", recursive=True))
    files = []
    for f in all_files:
        try:
            cls = int(Path(f).parent.name)
        except ValueError:
            cls = None
        if cls in REFERENCE_CLASSES:
            files.append(f)
        else:
            logger.warning("ignoring non-reference-class wav %s", f)
    if not files:
        raise RuntimeError("No reference embeddings found. Please check reference_root.")
    embeds, files = encode_files_striped(wrapper, files, sample_rate, batch_size, mesh=mesh)
    by_class: dict[int, list[np.ndarray]] = {k: [] for k in REFERENCE_CLASSES}
    for f, e in zip(files, embeds):
        by_class[int(Path(f).parent.name)].append(e)
    labels = [k for k in REFERENCE_CLASSES if by_class[k]]
    means = np.stack([np.mean(by_class[k], axis=0) for k in labels])
    return means.astype(np.float32), labels


@fp32_products
def _score_classes(u: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of `u` normalised, times the normalised class means: a true fp32
    product (TF32 would move near-tied scores), then argmax and max."""
    sims = torch.matmul(u / torch.linalg.vector_norm(u, dim=1, keepdim=True), m.T)  # (U, C)
    return sims.argmax(dim=1), sims.max(dim=1).values


def assign_classes(sample_embeds: np.ndarray, class_means: np.ndarray, mesh=None,
                   device=None) -> tuple[np.ndarray, np.ndarray]:
    """-> (best_class_idx (U,), best_score (U,)) by cosine similarity, on
    `device` (None: cuda). With `mesh` the rows are padded to a multiple of
    its local entries and each entry scores a contiguous run of them; over
    ranks every rank holds every row (`encode_files_striped` gathered them),
    so each scores them on its own device."""
    means_n = class_means / np.linalg.norm(class_means, axis=1, keepdims=True)
    devices = [resolve_device(device)] if mesh is None else list(mesh.devices)
    u = torch.from_numpy(np.asarray(sample_embeds, dtype=np.float32))
    m = torch.from_numpy(np.asarray(means_n, dtype=np.float32))
    pad = (-len(u)) % len(devices)
    if pad:
        u = torch.cat([u, torch.zeros((pad, u.shape[1]))])
    per = len(u) // len(devices)
    parts = [_score_classes(u[i * per : (i + 1) * per].to(d), m.to(d)) for i, d in enumerate(devices)]
    idx = torch.cat([p[0].cpu() for p in parts])[: len(sample_embeds)]
    val = torch.cat([p[1].cpu() for p in parts])[: len(sample_embeds)]
    return idx.numpy(), val.numpy()


def curate_library(
    wrapper,
    sample_pack_root: str,
    reference_root: str,
    sample_rate: int,
    batch_size: int = 32,
    num_bins: int = 10,
    mesh=None,
) -> Path:
    """Encode G and U, assign, bin, copy. Returns the output root."""
    validate_num_bins(num_bins)
    # sorted: the stripes and the gathered indices need one order on every rank
    wav_files = sorted(glob(f"{sample_pack_root}/**/*.[Ww][Aa][Vv]", recursive=True))
    logger.info("library: %d files", len(wav_files))
    class_means, labels = reference_class_means(wrapper, reference_root, sample_rate, batch_size, mesh=mesh)
    sample_embeds, wav_files = encode_files_striped(wrapper, wav_files, sample_rate, batch_size, mesh=mesh)
    pmesh = _process_mesh(wrapper, mesh)
    local = None if mesh is None or pmesh is not None else mesh
    best_idx, best_score = assign_classes(sample_embeds, class_means, local,
                                          device=None if local is not None else wrapper.device)

    augmented_root = _augmented_root_for(reference_root)
    if pmesh is not None and pmesh.rank != 0:
        # every rank holds the whole assignment, but rank 0 alone writes the
        # tree; wait until it has (and raise here if it failed)
        _allgather_ok(pmesh, None, "bin copy")
        return augmented_root
    copy_err: str | None = None
    try:
        if augmented_root.exists():
            shutil.rmtree(augmented_root)
        augmented_root.mkdir(parents=True, exist_ok=True)
        # the copy is I/O-bound: a thread pool, destination directories made first
        jobs: list[tuple[str, Path]] = []
        dest_dirs = set()
        for path, ci, score_value in zip(wav_files, best_idx, best_score):
            dest_dir = augmented_root / str(labels[int(ci)]) / score_to_bin_label(float(score_value), num_bins)
            dest_dirs.add(dest_dir)
            jobs.append((path, dest_dir / Path(path).name))
        for d in dest_dirs:
            d.mkdir(parents=True, exist_ok=True)

        def _copy(job: tuple[str, Path]) -> int:
            src, dst = job
            try:
                shutil.copy2(src, dst)
                return 1
            except OSError as e:
                logger.warning("Failed to copy %s: %s", src, e)
                return 0

        n_workers = min(16, os.cpu_count() or 1)
        if n_workers > 1:
            with ThreadPoolExecutor(n_workers) as pool:
                copied = sum(pool.map(_copy, jobs, chunksize=64))
        else:
            copied = sum(map(_copy, jobs))
        logger.info("Copied: %d", copied)
    except Exception as e:  # noqa: BLE001 - the writer must still reach the barrier
        if pmesh is None:
            raise
        logger.exception("bin copy failed on the writer process")
        copy_err = f"{type(e).__name__}: {e}"
    if pmesh is not None:
        _allgather_ok(pmesh, copy_err, "bin copy")
    return augmented_root


def copy_originals_to_augmented(reference_root: str, augmented_root: str | Path | None = None) -> Path:
    """Copy the hand-curated originals into `<class>/gold/` bins."""
    augmented_root = Path(augmented_root) if augmented_root else _augmented_root_for(reference_root)
    for f in glob(f"{reference_root}/**/*.[Ww][Aa][Vv]", recursive=True):
        dest = augmented_root / Path(f).parent.name / "gold"
        dest.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, dest / Path(f).name)
    return augmented_root


def convert_augmented_to_hdf5(input_root: str, output_prefix: str, sample_rate: int,
                              overwrite: bool = False) -> Path:
    """`<label>/<bin>/<name>.wav` tree -> `<prefix>@<sr>.hdf5` with gzip
    datasets and the flat `/index/*` tables (needs h5py)."""
    import h5py

    input_root = Path(input_root)
    output_path = Path(f"{output_prefix}@{sample_rate}.hdf5")
    if output_path.exists():
        if overwrite:
            output_path.unlink()
        else:
            raise FileExistsError(f"Output file exists: {output_path}")

    wav_files = sorted(glob(str(input_root / "**" / "*.[Ww][Aa][Vv]"), recursive=True))
    index = {"paths": [], "labels": [], "bins": [], "sample_rates": [], "lengths": []}
    with h5py.File(output_path, "w") as h5:
        for wav_path in wav_files:
            rel = Path(wav_path).relative_to(input_root)
            if len(rel.parts) < 3:
                continue
            label, bin_label = rel.parts[0], rel.parts[1]
            try:
                wave = normalize(load_and_resample(wav_path, sample_rate)).astype(np.float32)
            except Exception as e:  # noqa: BLE001 - one bad file must not end the packing
                logger.warning("Failed to load %s: %s", wav_path, e)
                continue
            grp = h5.require_group(label).require_group(bin_label)
            name = Path(wav_path).stem
            suffix = 1
            ds_name = name
            while ds_name in grp:
                suffix += 1
                ds_name = f"{name}_{suffix}"
            ds = grp.create_dataset(ds_name, data=wave, dtype="float32", compression="gzip")
            ds.attrs["sample_rate"] = sample_rate
            ds.attrs["path"] = str(rel)
            ds.attrs["label"] = label
            ds.attrs["bin"] = bin_label
            ds.attrs["num_samples"] = int(wave.shape[0])
            index["paths"].append(str(rel))
            index["labels"].append(label)
            index["bins"].append(bin_label)
            index["sample_rates"].append(sample_rate)
            index["lengths"].append(int(wave.shape[0]))

        ig = h5.create_group("index")
        ig.create_dataset("paths", data=index["paths"], compression="gzip")
        ig.create_dataset("labels", data=index["labels"], compression="gzip")
        ig.create_dataset("bins", data=index["bins"], compression="gzip")
        ig.create_dataset("sample_rates", data=np.asarray(index["sample_rates"], np.int32), compression="gzip")
        ig.create_dataset("lengths", data=np.asarray(index["lengths"], np.int64), compression="gzip")
    logger.info("Wrote %d items to %s", len(index["paths"]), output_path)
    return output_path
